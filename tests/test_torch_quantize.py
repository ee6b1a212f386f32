"""Int8 and bf16 serving in the port against the JAX package, on the CPU.

* Quantization (`quantize_kernel`, `quantize_params`, `quantized_bytes`)
  is exact: torch's round / clamp / division give JAX's q and scale bit
  for bit, so the tests ask for equality.
* The plain int8 GEMM (`qmm_reference`, what `quantized_matmul` runs on
  CPU tensors) against the JAX package's Pallas kernel run interpreted
  (`use_pallas=True, interpret=True`, as tests/test_quantize.py runs it):
  both take bf16(x) times the exact integer weight, sum in f32 and scale
  the sum. f32 output: atol 3e-6, the same exact products summed over
  K <= 512 in another order (measured <= 7.2e-7 at |out| <= 4.4). bf16
  output: rtol 2^-7, one bf16 rounding step, which a last-bit difference
  of the f32 sum can flip (measured 2e-3 at 4.19, once in 8.5e3 values).
* The network at tiny width (emb 128, so that `min_dim=128` quantizes
  every projection, as tests/test_quantize.py does) in bf16 and in int8
  against the JAX network on the CPU. Tolerance: max |diff| <= 2.5% of
  the output's max and relative RMS <= 2% (measured 0.93% and 0.91%).
  It is loose by nature: JAX's bf16 attention on the CPU is the einsum
  path, whose scores, bias and softmax are bf16, where the port's plain
  attention computes in f32 and rounds once; and JAX's int8 network on the
  CPU runs `_qmm_xla`, which rounds the dequantized weight to bf16 and
  multiplies in bf16, where the port keeps the integer weight exact and
  scales the f32 sum. Every such difference is a bf16 rounding step
  (2^-8 relative), carried through the residual stream. The -1e10 key-mask
  bias is built in bf16 by JAX and in f32 by the port: both are -1e10 to
  three digits, and both drive a masked key's weight to exactly 0.
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
from music_spectrogram_diffusion_tpu.ops import quantize as jax_quantize
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.cli import synthesize_midi
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.infer import synthesize
from music_spectrogram_diffusion_tpu_torch.midi import midi_io
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network
from music_spectrogram_diffusion_tpu_torch.ops import quantize

WIDTHS = dict(emb_dim=128, num_heads=2, head_dim=64, mlp_dim=256)
NET_MAX_REL, NET_RMS_REL = 2.5e-2, 2e-2


def _close_bf16_level(got, want):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  assert got.shape == want.shape
  peak = np.abs(want).max()
  assert np.abs(got - want).max() <= NET_MAX_REL * peak
  rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
  assert rms <= NET_RMS_REL


class _Tiny128(config.ExperimentConfig):
  """context_tiny at emb 128 (quantizable with min_dim=128)."""

  def network(self):
    return dataclasses.replace(super().network(), **WIDTHS)


def _jax_net_config(dtype):
  return dataclasses.replace(jax_config.network_config(
      "tiny", with_context=True, dropout_rate=0.0,
      dtype=dtype), **WIDTHS)


def _to_np(a):
  return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# quantize_kernel, quantize_params, quantized_bytes: exact.
# ---------------------------------------------------------------------------


def _kernel(kind):
  r = np.random.RandomState(11)
  w = r.randn(384, 256).astype(np.float32) * 0.05
  if kind == "bf16_rounded":
    w = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
  elif kind == "zeros":
    w = np.zeros_like(w)
  elif kind == "zero_columns":
    w[:, ::7] = 0.0
  return w


@pytest.mark.parametrize("kind", ["random", "bf16_rounded", "zeros",
                                  "zero_columns"])
def test_quantize_kernel_bit_exact(kind):
  w = _kernel(kind)
  q_j, s_j = jax_quantize.quantize_kernel(jnp.asarray(w))
  q_t, s_t = quantize.quantize_kernel(torch.from_numpy(w))
  assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
  np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
  np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
  np.testing.assert_array_equal(
      quantize.dequantize_kernel(q_t, s_t).numpy(),
      np.asarray(jax_quantize.dequantize_kernel(q_j, s_j)))


def test_quantize_kernel_from_bf16_storage():
  """A bf16-stored kernel quantizes from its bf16 values, as in JAX."""
  w = _kernel("random")
  q_j, s_j = jax_quantize.quantize_kernel(
      jnp.asarray(w).astype(jnp.bfloat16))
  q_t, s_t = quantize.quantize_kernel(
      torch.from_numpy(w).to(torch.bfloat16))
  np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
  np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


@pytest.fixture(scope="module")
def tiny():
  """Tiny128 float params from Flax init, the inputs, and the port's float
  module for convert.py."""
  r = np.random.RandomState(0)
  tokens = r.randint(1, 200, (2, 24)).astype(np.int32)
  tokens[1, 15:] = 0
  context = r.randn(2, 16, 128).astype(np.float32)
  ctx_mask = np.zeros((2, 16), bool)
  ctx_mask[0, :11] = True  # row 1: no context (a song's first segment)
  flax_module = jax_network.ContextTransformer(
      config=_jax_net_config("float32"))
  params = flax.core.unfreeze(flax_module.init(
      jax.random.PRNGKey(0), encoder_input_tokens=jnp.asarray(tokens),
      encoder_continuous_inputs=jnp.asarray(context),
      encoder_continuous_mask=jnp.asarray(ctx_mask),
      decoder_input_tokens=jnp.zeros((2, 16, 128)),
      decoder_noise_time=jnp.ones((2,)), enable_dropout=False)["params"])
  experiment = _Tiny128(size="tiny", dropout_rate=0.0)
  float_module = network.ContextTransformer(experiment.network())
  return dict(params=params, experiment=experiment,
              float_module=float_module,
              state=convert.flax_to_state_dict(params, float_module),
              tokens=tokens, context=context, ctx_mask=ctx_mask,
              z=r.randn(4, 16, 128).astype(np.float32),
              time=np.array([0.3, 0.9, 0.3, 0.9], np.float32))


def _jax_flat(tree):
  return {convert.torch_name(k): v for k, v in convert.flatten(tree).items()}


@pytest.mark.parametrize("cast_first", [False, True])
def test_quantize_params_matches_jax(tiny, cast_first):
  params, state = tiny["params"], tiny["state"]
  if cast_first:
    params = jax_inference.cast_params_bf16(params)
    state = inference.cast_params_bf16(state)
  want = _jax_flat(jax_quantize.quantize_params(params, min_dim=128))
  got = quantize.quantize_params(state, min_dim=128)
  assert set(got) == set(want)
  quantized = {k for k, v in want.items() if np.asarray(v).dtype == np.int8}
  assert quantized == {k for k, v in got.items() if v.dtype == torch.int8}
  # Every projection of the tiny128 model is quantized but the output one.
  assert len(quantized) == sum(
      1 for k in state if k.endswith(".kernel")) - 1
  assert "decoder.spec_out_dense.kernel" not in quantized
  assert got["decoder.spec_out_dense.kernel"].dtype == torch.float32
  for name in quantized:
    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    np.testing.assert_array_equal(got[name + "_scale"].numpy(),
                                  np.asarray(want[name + "_scale"]))
  assert quantize.quantized_bytes(got) == jax_quantize.quantized_bytes(
      jax_quantize.quantize_params(params, min_dim=128))


def test_quantize_params_default_min_dim(tiny):
  """min_dim 512 (the default) at emb 128: only the 512x512 time embedding
  kernel qualifies, in both packages."""
  got = quantize.quantize_params(tiny["state"])
  assert {k for k, t in got.items() if t.dtype == torch.int8} == {
      "decoder.time_emb_dense1.kernel"}
  want = jax_quantize.quantize_params(tiny["params"])
  assert quantize.quantized_bytes(got) == jax_quantize.quantized_bytes(want)


def test_cast_params_bf16_matches_jax(tiny):
  want = _jax_flat(jax_inference.cast_params_bf16(tiny["params"]))
  got = inference.cast_params_bf16(tiny["state"])
  assert set(got) == set(want)
  for name, t in got.items():
    w = np.asarray(want[name])
    assert str(t.dtype).replace("torch.", "") == w.dtype.name, name
    np.testing.assert_array_equal(t.float().numpy(), w.astype(np.float32))
  assert got["decoder.spec_out_dense.kernel"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The plain GEMM against the interpreted Pallas kernel.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 7, 16, 100, 256])
@pytest.mark.parametrize("k", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gemm_matches_pallas_kernel(m, k, dtype):
  r = np.random.RandomState(m * 1000 + k)
  x = r.randn(m, k).astype(np.float32)
  w = (r.randn(k, 256) / np.sqrt(k)).astype(np.float32)
  q, s = jax_quantize.quantize_kernel(jnp.asarray(w))
  want = _to_np(jax_quantize.quantized_matmul(
      jnp.asarray(x).astype(dtype), q, s, use_pallas=True, interpret=True,
      partitioned=False))
  x_t = torch.from_numpy(x).to(getattr(torch, dtype))
  got = quantize.quantized_matmul(x_t, torch.from_numpy(np.array(q)),
                                  torch.from_numpy(np.array(s)))
  assert got.dtype == x_t.dtype and got.shape == (m, 256)
  if dtype == "float32":
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-6)
  else:
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=0)


def test_quantized_matmul_mixed_dtypes_and_errors():
  r = np.random.RandomState(3)
  x = torch.from_numpy(r.randn(3, 128).astype(np.float32))
  q, s = quantize.quantize_kernel(torch.from_numpy(
      r.randn(128, 128).astype(np.float32)))
  f32_out = quantize.quantized_matmul(x.to(torch.bfloat16), q, s,
                                      out_dtype=torch.float32)
  assert f32_out.dtype == torch.float32
  # The kernel rounds x to bf16: an f32 x and its bf16 rounding agree.
  np.testing.assert_array_equal(
      quantize.quantized_matmul(x, q, s).numpy(), f32_out.numpy())
  with pytest.raises(TypeError):
    quantize.quantized_matmul(x, q.float(), s)
  with pytest.raises(ValueError):
    quantize.quantized_matmul(x, q[:64], s)


@pytest.mark.parametrize("m,k,n,want", [
    (2, 3072, 1536, (quantize.GEMV, 8)),   # FiLM: 12 column blocks
    (1, 3072, 3072, (quantize.GEMV, 2)),   # 96 blocks of 32 columns
    (512, 768, 768, (quantize.WGMMA, 4)),  # 48 tiles of 128x64
    (256, 2048, 768, (quantize.WGMMA, 8)),  # 24 tiles
    (512, 768, 2048, (quantize.WGMMA, 2)),  # 128 tiles
    (2304, 768, 768, (quantize.WGMMA, 1)),  # 216 tiles: every SM has one
    (quantize.GEMV_MAX_M, 768, 3072, (quantize.GEMV, 8)),  # the cut-off
    (quantize.GEMV_MAX_M + 1, 768, 3072, (quantize.WGMMA, 4)),
    (256, 768, 2048, (quantize.WGMMA, 2)),  # 4 would make 256 blocks
])
def test_split_k_policy(m, k, n, want):
  """The kernel's plan on a 132-SM card (H100 SXM): the route by M, and K
  split into a power of two of ranges (at most MAX_SPLITS, dividing the K
  steps): on the tensor cores the fewest that fill the card, none once
  every SM has a tile, half as many where clusters of 4 or more would make
  over 1.5 blocks an SM; on GEMV the fewest that leave a thread one batch
  of loads within 0.7-2 blocks an SM."""
  got = quantize.plan(m, k, n, 132)
  assert (got.route, got.splits) == want
  assert (k // quantize.k_step(got.config)) % got.splits == 0
  assert 1 <= got.splits <= quantize.MAX_SPLITS


# ---------------------------------------------------------------------------
# DenseGeneral's int8 form, convert.py, build_model's casts.
# ---------------------------------------------------------------------------


def test_dense_general_int8_form():
  dense = layers.DenseGeneral(128, (2, 64), dtype=torch.bfloat16)
  dense.init_weights(torch.Generator().manual_seed(0))
  x = torch.randn(3, 5, 128)
  q, s = quantize.quantize_kernel(dense.kernel.data)
  with pytest.raises(ValueError):
    layers.quantize_dense_(dense, q[:64], s)
  layers.quantize_dense_(dense, q, s)
  assert dense.is_int8 and dense.kernel.dtype == torch.int8
  assert set(dict(dense.named_parameters())) == {"kernel", "kernel_scale"}
  y = dense(x)
  assert y.dtype == torch.bfloat16 and y.shape == (3, 5, 2, 64)
  np.testing.assert_array_equal(
      y.float().numpy(),
      quantize.qmm_reference(x.reshape(15, 128).to(torch.bfloat16), q, s
                             ).float().reshape(3, 5, 2, 64).numpy())
  with pytest.raises(ValueError):
    layers.quantize_dense_(dense, q, s)


def test_convert_int8_tree(tiny):
  """A JAX int8 serving tree converts exactly and loads strictly; it equals
  the port's own bf16 cast + quantization of the converted f32 tree."""
  jax_tree = jax_quantize.quantize_params(
      jax_inference.cast_params_bf16(tiny["params"]), min_dim=128)
  got = convert.flax_to_state_dict(jax_tree, tiny["float_module"])
  want = quantize.quantize_params(inference.cast_params_bf16(tiny["state"]),
                                  min_dim=128)
  assert set(got) == set(want)
  for name, t in got.items():
    if want[name].dtype == torch.bfloat16:
      assert t.dtype == torch.float32  # bf16 leaves come over exactly
    else:
      assert t.dtype == want[name].dtype, name
    np.testing.assert_array_equal(t.float().numpy(),
                                  want[name].float().numpy())
  module = network.ContextTransformer(tiny["experiment"].network())
  inference.load_serving_state_(module, got)
  assert {k: v.dtype for k, v in module.state_dict().items()} == {
      k: v.dtype for k, v in got.items()}
  broken = dict(jax_tree)
  broken["decoder"] = dict(broken["decoder"])
  broken["decoder"]["time_emb_dense0"] = {
      "kernel": broken["decoder"]["time_emb_dense0"]["kernel"]}
  with pytest.raises(ValueError, match="kernel_scale"):
    convert.flax_to_state_dict(broken, tiny["float_module"])


class _Tiny512(config.ExperimentConfig):
  """One layer each at emb 512: the MLP, FiLM and time-embedding kernels
  pass the default min_dim of 512."""

  def network(self):
    return dataclasses.replace(
        super().network(), vocab_size=256, emb_dim=512, num_heads=2,
        head_dim=64, mlp_dim=512, num_encoder_layers=1, num_decoder_layers=1)


def test_build_model_quantizes_from_bf16_weights():
  experiment = _Tiny512(size="tiny", dropout_rate=0.0)
  f32 = inference.build_model(experiment, seed=3, device="cpu")
  int8 = inference.build_model(experiment, seed=3, device="cpu",
                               compute_dtype="int8")
  assert int8.module.config.dtype == torch.bfloat16
  want = quantize.quantize_params(
      inference.cast_params_bf16(f32.module.state_dict()))
  got = int8.module.state_dict()
  assert set(got) == set(want)
  for name in got:
    assert got[name].dtype == want[name].dtype, name
    assert torch.equal(got[name], want[name]), name
  n_int8 = sum(1 for t in got.values() if t.dtype == torch.int8)
  assert n_int8 == 2 + 2 + 3 * 3  # time, FiLM, the three MLPs
  # Quantizing the f32 weights instead gives other scales and flips q.
  from_f32 = quantize.quantize_params(f32.module.state_dict())
  name = "decoder.layers.0.mlp.wi_0.kernel"
  assert not torch.equal(from_f32[name + "_scale"], got[name + "_scale"])
  bf16 = inference.InferenceModel(experiment, seed=3, device="cpu",
                                  compute_dtype="bfloat16")
  assert bf16.experiment.dtype == "bfloat16"
  f32_state = f32.module.state_dict()
  for name, t in bf16.model.module.state_dict().items():
    if "spec_out_dense" in name:
      assert t.dtype == torch.float32 and torch.equal(t, f32_state[name])
    elif "_film." in name:
      # FiLM computes in float32: its kernel is stored as the bf16-rounded
      # values in float32, so no call casts it.
      assert t.dtype == torch.float32, name
      assert torch.equal(t, f32_state[name].bfloat16().float()), name
    else:
      assert t.dtype == torch.bfloat16, name
  # No float projection casts its kernel per call in either serving dtype.
  for model in (bf16.model, int8):
    for sub in model.module.modules():
      if isinstance(sub, layers.DenseGeneral) and not sub.is_int8:
        assert sub.kernel.dtype == sub.dtype
  with pytest.raises(ValueError, match="compute_dtype"):
    inference.build_model(experiment, device="cpu", compute_dtype="int4")


# ---------------------------------------------------------------------------
# The network in bf16 and int8 against JAX.
# ---------------------------------------------------------------------------


def _jax_forward(params, m):
  module = jax_network.ContextTransformer(config=_jax_net_config("bfloat16"))
  enc = module.apply({"params": params}, jnp.asarray(m["tokens"]),
                     jnp.asarray(m["context"]), jnp.asarray(m["ctx_mask"]),
                     enable_dropout=False, method=module.encode)
  kv = module.apply({"params": params}, enc,
                    method=module.precompute_cross_kv)
  out = module.apply({"params": params}, enc, jnp.asarray(m["z"]),
                     jnp.asarray(m["time"]), enable_dropout=False,
                     cross_kv=kv, cond_rows=2, method=module.decode)
  assert out.dtype == jnp.bfloat16
  return [_to_np(e) for e, _ in enc], _to_np(out)


def _port_forward(model, m):
  module = model.model.module
  with torch.no_grad():
    enc = module.encode(torch.from_numpy(m["tokens"]),
                        torch.from_numpy(m["context"]),
                        torch.from_numpy(m["ctx_mask"]))
    kv = module.precompute_cross_kv(enc)
    out = module.decode(enc, torch.from_numpy(m["z"]),
                        torch.from_numpy(m["time"]), cross_kv=kv,
                        cond_rows=2)
  assert out.dtype == torch.bfloat16
  assert all(e.dtype == torch.bfloat16 for e, _ in enc)
  assert all(k.dtype == torch.bfloat16 for layer in kv for k, _ in layer)
  return [e.float().numpy() for e, _ in enc], out.float().numpy()


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "int8"])
def test_network_matches_jax(tiny, compute_dtype):
  if compute_dtype == "bfloat16":
    jax_params = jax_inference.cast_params_bf16(tiny["params"])
    state = tiny["state"]
  else:
    jax_params = jax_quantize.quantize_params(
        jax_inference.cast_params_bf16(tiny["params"]), min_dim=128)
    state = convert.flax_to_state_dict(jax_params, tiny["float_module"])
  model = inference.InferenceModel(tiny["experiment"], state_dict=state,
                                   device="cpu", compute_dtype=compute_dtype)
  before = quantize.quantized_matmul.launches
  enc_j, out_j = _jax_forward(jax_params, tiny)
  enc_p, out_p = _port_forward(model, tiny)
  assert quantize.quantized_matmul.launches == before  # none on the CPU
  for got, want in zip(enc_p, enc_j):
    _close_bf16_level(got, want)
  _close_bf16_level(out_p, out_j)


# ---------------------------------------------------------------------------
# A two-segment int8 render from a MIDI file against the JAX Synthesizer.
# ---------------------------------------------------------------------------

LENGTHS = {"inputs": 64, "targets": 32, "targets_context": 32}
STEPS, INTERVAL = 10, (0.1, 0.8)


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
def int8_renders(tiny, tmp_path_factory):
  from music_spectrogram_diffusion_tpu.data import synthetic
  path = str(tmp_path_factory.mktemp("midi") / "song.mid")
  midi_io.write_midi_file(synthetic.random_note_sequence(
      np.random.RandomState(2), duration=0.7, notes_per_second=8.0), path)
  experiment = inference.with_sampler(
      dataclasses.replace(tiny["experiment"],
                          task_lengths=config.TaskLengths(**LENGTHS)),
      sampler_steps=STEPS, sampler_name="sde-dpm++",
      guidance_interval=INTERVAL)
  segments = synthesize_midi.segment_midi(
      midi_io.read_midi_file(path),
      synthesize_midi.SegmentSettings.for_experiment(experiment), LENGTHS)
  assert len(segments) == 2

  params = jax.tree.map(lambda x: x, tiny["params"])
  out = params["decoder"]["spec_out_dense"]
  # As tests/test_torch_synthesize.py: the random init's eps is so large
  # that float noise dominates x0; a trained model's eps is O(1).
  out["kernel"] = out["kernel"] * 0.1
  jax_params = jax_quantize.quantize_params(
      jax_inference.cast_params_bf16(params), min_dim=128)
  jax_cfg = jd.DiffusionConfig(
      guidance=jd.GuidanceConfig(interval=INTERVAL),
      sampler=jd.SamplerConfig(name="sde-dpm++", num_steps=STEPS))
  model = jax_model.ContextDiffusionModel(
      jax_network.ContextTransformer(config=_jax_net_config("bfloat16")),
      jax_cfg, jax_codecs.MelGan())
  rng = jax.random.PRNGKey(5)
  want = jax_synth.Synthesizer(model, jax_params, LENGTHS).render_song(
      segments, rng=rng, vocode=False)
  # JAX's own bf16 render of the song, without quantization: the yardstick
  # the int8 limits are set below.
  want_bf16 = jax_synth.Synthesizer(
      model, jax_inference.cast_params_bf16(params), LENGTHS).render_song(
          segments, rng=rng, vocode=False)

  port = inference.InferenceModel(
      experiment, device="cpu", compute_dtype="int8",
      state_dict=convert.flax_to_state_dict(jax_params,
                                            tiny["float_module"]))
  dtypes = []  # the context each segment is fed, and what predict returns
  predict = port.model.predict

  def recording_predict(batch, noise, **options):
    dtypes.append(batch["encoder_continuous_inputs"].dtype)
    out = predict(batch, noise, **options)
    dtypes.append(out.dtype)
    return out

  port.model.predict = recording_predict
  got = port.synthesizer().render_song(segments, noise=_jax_noise(rng))
  return want, want_bf16, got, port, dtypes


def test_int8_render_matches_jax(int8_renders):
  """Tolerance on the features (range log(1e-5)..4): mean |diff| <= 0.026,
  99th percentile <= 0.22, max <= 2.5 (measured 0.018, 0.15 and 1.14).
  Each of the 20 decoder forwards differs from JAX's at the bf16 level
  (test_network_matches_jax), and the sampler carries those differences
  into x0 near its clip. The mean and 99th-percentile limits lie below
  JAX's own gap between its bf16 and int8 renders of this song (0.034 and
  0.29, checked here), so a port that rendered in bf16 without
  quantizing would fail them."""
  want, want_bf16, got, port, dtypes = int8_renders
  assert got.mel.shape == want.mel.shape == (64, 128)
  assert np.all(np.isfinite(got.mel))
  d = np.abs(got.mel - want.mel)
  jax_gap = np.abs(want_bf16.mel - want.mel)
  assert d.mean() <= 0.026 < jax_gap.mean()
  assert np.percentile(d, 99) <= 0.22 < np.percentile(jax_gap, 99)
  assert d.max() <= 2.5
  # The sampler's state and the chained context stay float32 while the
  # network computes in bf16 with int8 weights.
  assert dtypes == [torch.float32] * 4
  assert got.mel.dtype == np.float32
  module = port.model.module
  assert module.decoder.layers[0].mlp.wo.is_int8
  assert module.decoder.layers[0].mlp_film.dense.is_int8
  assert not module.decoder.spec_out_dense.is_int8
  assert module.decoder.spec_out_dense.kernel.dtype == torch.float32
