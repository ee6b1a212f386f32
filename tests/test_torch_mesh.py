"""parallel/mesh.py on one process: the parameters' splits against the JAX
package's `param_shardings` and `quantized_param_shardings` on a 4x2 mesh
(conftest gives JAX 8 CPU devices), the rules, the 1x1 mesh and the draws
at the global shape. The collectives run in tests/test_torch_parallel.py
over spawned ranks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.infer import inference as jax_inference
from music_spectrogram_diffusion_tpu.ops import quantize as jax_quantize
from music_spectrogram_diffusion_tpu.parallel import mesh as jax_mesh
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.ops import quantize
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
from music_spectrogram_diffusion_tpu_torch.train import trainer
from tests import torch_parallel_worker as worker

WIDE = dict(emb_dim=128, num_heads=2, head_dim=64, mlp_dim=256)

_SHAPES = {
    "context": {"encoder_input_tokens": ((1, 32), jnp.int32),
                "encoder_continuous_inputs": ((1, 16, 128), jnp.float32),
                "encoder_continuous_mask": ((1, 16), jnp.bool_),
                "decoder_target_tokens": ((1, 16, 128), jnp.float32)},
    "notes": {"encoder_input_tokens": ((1, 32), jnp.int32),
              "decoder_target_tokens": ((1, 16, 128), jnp.float32)},
    "ar": {"encoder_input_tokens": ((1, 16), jnp.int32),
           "decoder_input_tokens": ((1, 8, 128), jnp.float32),
           "decoder_target_tokens": ((1, 8, 128), jnp.float32)},
}
PRESETS = {"context_tiny": "context", "diffusion_tiny": "notes",
           "ar_tiny": "ar"}


def _jax_specs(preset, widths=None, int8=False):
  """JAX's PartitionSpec of each parameter on a 4x2 mesh, by the port's
  state_dict name, as tuples of one entry a dim."""
  experiment = jax_config.preset(preset)
  jm = jax_inference.build_model(experiment)
  if widths:
    jm.module = jm.module.clone(config=dataclasses.replace(
        jm.module.config, **widths))
  shapes = _SHAPES[PRESETS[preset]]
  mesh = jax_mesh.make_mesh(data=4, model=2)
  with mesh, jax_mesh.axis_rules():
    variables = jax.jit(lambda key: jm.init_variables(
        key, {k: s for k, (s, _) in shapes.items()},
        {k: t for k, (_, t) in shapes.items()}))(jax.random.PRNGKey(0))
  shardings = jax_mesh.param_shardings(variables, mesh)
  params = variables["params"]
  if int8:
    params = jax_quantize.quantize_params(params, min_dim=128)
    shardings = jax_quantize.quantized_param_shardings(params, shardings,
                                                       mesh)
  flat_params = convert.flatten(jax.tree.map(np.asarray, params))
  flat = convert.flatten(shardings)
  out = {}
  for path, sharding in flat.items():
    ndim = np.ndim(flat_params[path])
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    out[convert.torch_name(path)] = spec
  return out


def _port_module(preset, widths=None):
  experiment = config.preset(preset)
  if widths:
    experiment = worker.widened(experiment, widths)
  return inference.network(experiment)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_param_shardings_equal_jax_on_4x2(preset):
  """Every parameter's split (the mesh axis of each dim) is JAX's."""
  want = _jax_specs(preset)
  got = mesh_lib.param_shardings(_port_module(preset), mesh_lib.Mesh(4, 2))
  assert set(got) == set(want)
  for name, spec in want.items():
    assert got[name] == spec, (name, got[name], spec)
  assert any("model" in spec for spec in got.values())


def test_int8_param_shardings_equal_jax_on_4x2():
  """The int8 tree (the tiny model at emb 128, quantized at min_dim 128):
  each int8 kernel keeps its float kernel's split and each kernel_scale
  follows N, as JAX's quantized_param_shardings."""
  want = _jax_specs("context_tiny", widths=WIDE, int8=True)
  module = _port_module("context_tiny", widths=WIDE)
  module.init_weights(torch.Generator().manual_seed(0))
  state = quantize.quantize_params(module.state_dict(), min_dim=128)
  inference.load_serving_state_(module, state)
  got = mesh_lib.param_shardings(module, mesh_lib.Mesh(4, 2))
  scales = [n for n in got if n.endswith("kernel_scale")]
  assert len(scales) > 10
  assert set(got) == set(want)
  for name, spec in want.items():
    assert got[name] == spec, (name, got[name], spec)


def test_logical_axes_are_jax_layers():
  module = _port_module("context_tiny")
  specs = mesh_lib.param_logical_specs(module)
  assert set(specs) == set(dict(module.named_parameters()))
  layer = "decoder.layers.0."
  assert specs[layer + "mlp.wi_0.kernel"] == ("embed", "mlp")
  assert specs[layer + "mlp.wo.kernel"] == ("mlp", "embed")
  assert specs[layer + "self_attention.query.kernel"] == ("embed",
                                                          "joined_kv")
  assert specs[layer + "self_attention.out.kernel"] == ("joined_kv", "embed")
  assert specs[layer + "mlp_film.dense.kernel"] == ("vocab", "embed")
  assert specs["token_encoder.token_embedder.embedding"] == ("vocab",
                                                             "embed")
  assert specs["decoder.spec_out_dense.kernel"] == ("embed", "vocab")
  assert specs[layer + "pre_mlp_norm.scale"] == ("embed",)


def test_a_split_that_does_not_divide_is_replicated():
  """3 heads over 2: the attention stays whole (shards hold whole heads);
  a vocab of 3 rows likewise."""
  attn = layers.MultiHeadAttention(64, 3, 32, 64)
  mesh = mesh_lib.Mesh(1, 2)
  assert mesh_lib.param_shardings(attn, mesh) == {
      f"{n}.kernel": (None, None) for n in ("query", "key", "value", "out")}
  assert mesh_lib.param_shardings(layers.Embed(3, 8), mesh) == {
      "embedding": (None, None)}
  assert mesh_lib.param_shardings(layers.Embed(4, 8), mesh) == {
      "embedding": ("model", None)}


def test_one_mesh_of_one_without_a_process_group():
  mesh = mesh_lib.make_mesh()
  assert (mesh.shape, mesh.rank, mesh.size) == ({"data": 1, "model": 1}, 0, 1)
  t = torch.arange(6.0)
  assert mesh.all_reduce_(t, "model") is t and mesh.gather(t, "data", 0) is t
  for data, model in ((2, 1), (None, 2), (4, 2)):
    with pytest.raises(ValueError, match="devices"):
      mesh_lib.make_mesh(data=data, model=model)
  # JAX's batch_sharding and replicated: P('data') and P().
  assert mesh_lib.batch_sharding(mesh) == tuple(jax.sharding.PartitionSpec(
      "data"))
  assert mesh_lib.replicated(mesh) == tuple(jax.sharding.PartitionSpec())
  assert mesh_lib.parse_mesh("4x2") == (4, 2)
  for bad in ("4", "x2", "0x2", "2x2x2"):
    with pytest.raises(ValueError):
      mesh_lib.parse_mesh(bad)


@pytest.mark.parametrize("rank", range(4))
def test_rand_is_the_global_draw_block(rank):
  """Under a 2x2 mesh a rank's draw is its block of the global draw: rows
  by data index, the model-split dim by model index."""
  mesh = mesh_lib.Mesh(2, 2, rank=rank)
  with mesh:
    got = mesh_lib.rand((3, 4, 5), generator=torch.Generator().manual_seed(
        1), device="cpu", model_dim_=1)
    replicated = mesh_lib.rand((3, 5), generator=torch.Generator(
    ).manual_seed(1), device="cpu")
  full = torch.rand(6, 8, 5, generator=torch.Generator().manual_seed(1))
  d, m = divmod(rank, 2)
  assert torch.equal(got, full[3 * d:3 * d + 3, 4 * m:4 * m + 4])
  full = torch.rand(6, 5, generator=torch.Generator().manual_seed(1))
  assert torch.equal(replicated, full[3 * d:3 * d + 3])
  assert mesh_lib.current() is None


def test_the_1x1_mesh_trains_as_no_mesh():
  """Trainer(mesh=make_mesh()) with dropout: the one-device step, bit for
  bit."""
  experiment = config.preset("context_tiny")
  r = np.random.RandomState(0)
  batch = {"encoder_input_tokens": r.randint(1, 200, (2, 16)),
           "encoder_continuous_inputs": r.randn(2, 8, 128).astype(
               np.float32),
           "encoder_continuous_mask": np.ones((2, 8), bool),
           "decoder_target_tokens": r.randn(2, 8, 128).astype(np.float32),
           "decoder_target_mask": np.ones((2, 8), bool)}
  results = []
  for mesh in (None, mesh_lib.make_mesh()):
    t = trainer.Trainer(trainer.build_model(experiment, device="cpu"),
                        experiment.train, mesh=mesh)
    state, metrics = t.train_step(t.create_state(), batch, 1)
    results.append((metrics, t.full_params()))
  (m0, p0), (m1, p1) = results
  assert all(torch.equal(m0[k], m1[k]) for k in m0)
  assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_sharding_twice_on_one_mesh_changes_nothing():
  module = _port_module("context_tiny")
  mesh = mesh_lib.make_mesh()
  assert mesh_lib.shard_module_(module, mesh) is module
  assert mesh_lib.shard_module_(module, mesh) is module
  assert mesh_lib.module_mesh(module) is mesh
  assert not mesh_lib.splits_model(module)
  with pytest.raises(ValueError, match="sharded on"):
    mesh_lib.shard_module_(module, mesh_lib.make_mesh())


# The attention shapes of context_base (q_len, kv_len) and the kernels'
# block shapes on an H100 (132 SMs): the forward's (rows, keys) by dtype
# (tests/test_torch_attention_tc.py) and the backward's dq items
# (tests/test_torch_attention_bwd_plan.py).
ATTENTION_SHAPES = ((2048, 2048), (256, 256), (256, 2304))
FWD_TILES, DQ_ROWS, SMS = ((128, 64), (64, 64)), {2048: 192, 256: 128}, 132


@pytest.mark.parametrize("heads", [6, 3])
@pytest.mark.parametrize("q_len,kv_len", ATTENTION_SHAPES)
def test_attention_splits_at_the_local_heads(heads, q_len, kv_len):
  """The split-KV forward and the dq key split at the local heads of 1x2
  and 1x4 (6 and 3 of 12): the ranges cover the keys once, each starts
  below kv_len, and fewer heads split no less."""
  from music_spectrogram_diffusion_tpu_torch.ops import attention
  for batch in (1, 2, 8):
    plans = [(attention.kv_split, rows, keys) for rows, keys in FWD_TILES]
    plans.append((attention.dq_key_split, DQ_ROWS[q_len], 64))
    for split, rows, keys in plans:
      splits, per = split(batch, heads, q_len, kv_len, SMS, rows, keys)
      assert per % keys == 0 or splits == 1
      assert splits * per >= kv_len > (splits - 1) * per
      whole = split(batch, 2 * heads, q_len, kv_len, SMS, rows, keys)[0]
      assert splits >= whole
