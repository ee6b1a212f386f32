"""The port's training path against the JAX package's, at tiny size.

Every comparison feeds both sides the same numpy-seeded inputs; the random
draws of a step (eps, time, the condition drop) are JAX's own, handed to
the port through its provider, and dropout is off (`jax.random` bits
cannot be reproduced; dropout is checked by its statistics instead).

Tolerances: the diffusion input and loss 1e-6 (the same float32 formulas);
the model's loss 1e-5 relative and each gradient 3e-4 of its leaf's largest
entry (largest measured 7.6e-5: float32 sums in other orders, and the
timing embedding's sin/cos of arguments up to 2e4 rad, where XLA's and
PyTorch's float32 exp differ by an ulp, see tests/test_torch_network.py);
Adafactor 1e-6 relative and 1e-7 absolute after 3 updates of about 1e-2
each (the same float32 arithmetic; the means of the second moments are
summed in other orders, measured 9e-9); the synthetic batches and a
resumed CPU run exactly.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
from optax._src import factorized
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.data import synthetic as jax_synthetic
from music_spectrogram_diffusion_tpu.data import tasks as jax_tasks
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu.train import trainer as jax_trainer
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.cli import train as train_cli
from music_spectrogram_diffusion_tpu_torch.data import synthetic, tasks
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.autoregressive import (
    model as ar_model)
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model, network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d
from music_spectrogram_diffusion_tpu_torch.train import (
    checkpoints, loop, trainer)

LENGTHS = {"inputs": 64, "targets": 16, "targets_context": 16}


def _injected(eps, time, include):
  """A draws provider handing out JAX's draws."""
  arrays = [torch.from_numpy(np.array(x)) for x in (eps, time, include)]
  return lambda x0, cfg: tuple(arrays)


# ---------------------------------------------------------------------------
# Diffusion input and loss.
# ---------------------------------------------------------------------------

LOSSES = [(norm, kind, "eps") for norm in ("l1", "l2")
          for kind in ("eps", "x0", "max_x0_eps", "x0_and_eps")] + [
              ("l2", "x0", "v"), ("l1", "eps", "x0")]


@pytest.mark.parametrize("norm,kind,output", LOSSES)
def test_training_input_and_loss_match_jax(norm, kind, output):
  r = np.random.RandomState(3)
  x0 = r.uniform(-1, 1, (3, 5, 8)).astype(np.float32)
  out = r.randn(3, 5, 8).astype(np.float32)
  jcfg = jd.DiffusionConfig(loss_norm=norm, loss_type=kind,
                            model_output=output)
  tcfg = d.DiffusionConfig(loss_norm=norm, loss_type=kind,
                           model_output=output)
  z, eps, time, include = jd.training_input(jax.random.PRNGKey(4),
                                            jnp.asarray(x0), jcfg)
  got = d.training_input(_injected(eps, time, include),
                         torch.from_numpy(x0), tcfg)
  np.testing.assert_allclose(got[0].numpy(), np.asarray(z), rtol=1e-6,
                             atol=1e-6)
  want = jd.training_loss(jnp.asarray(x0), eps, z, time, jnp.asarray(out),
                          jcfg)
  loss = d.training_loss(torch.from_numpy(x0), *got[1:2], got[0], got[2],
                         torch.from_numpy(out), tcfg)
  np.testing.assert_allclose(loss.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)


def test_generator_draws():
  cfg = d.DiffusionConfig(guidance=d.GuidanceConfig(drop_condition_prob=0.25))
  x0 = torch.zeros(4000, 2, 3)
  eps, time, include = d.generator_draws(torch.Generator().manual_seed(0))(
      x0, cfg)
  assert eps.shape == x0.shape and time.shape == include.shape == (4000,)
  assert 0.0 <= time.min() and time.max() < 1.0
  assert abs(include.float().mean().item() - 0.75) < 0.03
  assert abs(eps.std().item() - 1.0) < 0.03
  again = d.generator_draws(torch.Generator().manual_seed(0))(x0, cfg)
  for a, b in zip((eps, time, include), again):
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# loss_fn and its gradients.
# ---------------------------------------------------------------------------


def _batch(rows=4):
  r = np.random.RandomState(0)
  batch = {
      "encoder_input_tokens": r.randint(1, 200, (rows, 24)).astype(np.int32),
      "encoder_continuous_inputs": (r.randn(rows, 16, 128) * 3 - 4).astype(
          np.float32),
      "encoder_continuous_mask": np.ones((rows, 16), bool),
      "decoder_target_tokens": (r.randn(rows, 16, 128) * 3 - 4).astype(
          np.float32),
      "decoder_target_mask": np.ones((rows, 16), bool),
  }
  batch["encoder_input_tokens"][1, 10:] = 0
  batch["encoder_continuous_mask"][0, 9:] = False
  batch["encoder_continuous_mask"][2] = False  # a song's first segment
  batch["decoder_target_mask"][3, 12:] = False
  return batch


def test_loss_fn_and_gradients_match_jax():
  batch = _batch()
  # Half the rows drop their condition, so the token encoder, the context
  # encoder and cross-attention all see all-masked rows.
  jcfg = jd.DiffusionConfig(guidance=jd.GuidanceConfig(
      drop_condition_prob=0.5))
  jm = jax_model.ContextDiffusionModel(
      jax_network.ContextTransformer(config=jax_config.network_config(
          "tiny", with_context=True, vocab_size=256, dropout_rate=0.0)),
      jcfg, jax_codecs.MelGan())
  params = jax.jit(lambda key: jm.init_variables(
      key, {k: v.shape for k, v in batch.items()},
      {k: v.dtype for k, v in batch.items()}))(
          jax.random.PRNGKey(0))["params"]
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  (loss, metrics), grads = jax.jit(jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, None), has_aux=True))(params)
  # JAX's draws for dropout_rng=None: the second half of PRNGKey(0).
  targets = jm.audio_codec.scale_features(
      jb["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  _, eps, time, include = jd.training_input(
      jax.random.split(jax.random.PRNGKey(0))[1], targets, jcfg)
  assert 0 < int(np.sum(include)) < len(include)

  module = network.ContextTransformer(config.network_config(
      "tiny", with_context=True, vocab_size=256, dropout_rate=0.0))
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  pm = model.ContextDiffusionModel(
      module, d.DiffusionConfig(guidance=d.GuidanceConfig(
          drop_condition_prob=0.5)), codecs.MelGan())
  got, got_metrics = pm.loss_fn(
      {k: torch.from_numpy(v) for k, v in batch.items()},
      _injected(eps, time, include))
  got.backward()
  np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
  for k, v in metrics.items():
    np.testing.assert_allclose(got_metrics[k].item(), float(v), rtol=1e-5,
                               err_msg=k)
  named = dict(module.named_parameters())
  flat = convert.flatten(jax.tree.map(np.asarray, grads))
  assert {convert.torch_name(k) for k in flat} == set(named)
  for path, want in flat.items():
    p = named[convert.torch_name(path)]
    got_g = (p.grad.numpy() if p.requires_grad
             else np.zeros(tuple(p.shape), np.float32))  # a fixed table
    want = np.asarray(want).reshape(got_g.shape)
    np.testing.assert_allclose(got_g, want, rtol=0,
                               atol=3e-4 * np.abs(want).max() + 1e-8,
                               err_msg=path)


# ---------------------------------------------------------------------------
# Adafactor, the LR schedule and MultiSteps against optax.
# ---------------------------------------------------------------------------

SHAPES = {"factored_rows": (256, 130), "factored_cols": (140, 300),
          "square": (128, 128), "narrow": (300, 100), "vector": (200,),
          "small_scale": (4, 4)}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_adafactor_matches_optax(microbatches):
  train_cfg = config.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                 num_microbatches=microbatches)
  tx = jax_trainer.make_optimizer(jax_config.TrainConfig(
      **dataclasses.asdict(train_cfg)))
  ours = trainer.make_optimizer(train_cfg)
  r = np.random.RandomState(9)
  params = {n: r.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
  params["small_scale"] *= 1e-5  # below the 1e-3 parameter-scale floor
  jp = {n: jnp.asarray(v) for n, v in params.items()}
  tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
  j_state, t_state = tx.init(jp), ours.init(tp)
  update = jax.jit(tx.update)
  for _ in range(3 * microbatches):
    g = {n: (r.randn(*s) * r.uniform(0.1, 10)).astype(np.float32)
         for n, s in SHAPES.items()}
    updates, j_state = update({n: jnp.asarray(v) for n, v in g.items()},
                              j_state, jp)
    jp = optax.apply_updates(jp, updates)
    t_updates, t_state = ours.update(
        {n: torch.from_numpy(v) for n, v in g.items()}, t_state, tp)
    if t_updates is not None:
      for n, u in t_updates.items():
        tp[n].add_(u)
  for n in SHAPES:
    assert not np.allclose(np.asarray(jp[n]), params[n])
    np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6,
                               atol=1e-7, err_msg=n)


def test_factoring_of_every_context_base_leaf_matches_optax():
  with torch.device("meta"):
    module = network.ContextTransformer(config.preset("context_base")
                                        .network())
  chosen = set()
  for name, p in module.named_parameters():
    shape = tuple(p.shape)
    want = factorized._factored_dims(shape, True, 128)
    assert trainer.factored_dims(shape) == want, name
    chosen.add(want)
  # 1-D scales, [768, x] projections and the [3072, 1536] FiLM kernels
  # take different branches.
  assert {None, (0, 1), (1, 0)} <= chosen


def test_warmup_constant_schedule_matches_jax():
  jax_schedule = jax_trainer.warmup_constant_schedule(1e-3, 1000)
  ours = trainer.warmup_constant_schedule(1e-3, 1000)
  for step in (0, 1, 499, 998, 999, 1000, 5000):
    assert ours(step) == float(jax_schedule(jnp.asarray(step, jnp.int32)))


# ---------------------------------------------------------------------------
# Dropout.
# ---------------------------------------------------------------------------


def test_dropout_statistics():
  x = torch.ones(8, 64, 256)
  gen = torch.Generator().manual_seed(0)
  y = layers.dropout(x, 0.1, gen, broadcast_dims=(-2,))
  assert torch.equal(torch.unique(y), torch.tensor([0.0, 1.0 / 0.9]))
  # One draw shared along the length axis, independent elsewhere.
  assert torch.equal(y, y[:, :1].expand_as(y))
  keep = (y[:, 0] > 0).float().mean().item()
  assert abs(keep - 0.9) < 0.01
  full = layers.dropout(x, 0.1, gen)
  assert not torch.equal(full, full[:, :1].expand_as(full))
  assert abs((full > 0).float().mean().item() - 0.9) < 0.005
  # Off without a generator or at rate 0.
  assert layers.dropout(x, 0.1, None) is x
  assert layers.dropout(x, 0.0, gen) is x


def test_attention_dropout_is_a_value_row_scale():
  """MultiHeadAttention's dropout keeps a key for all queries of a head
  ([b, h, kv], as JAX draws it) and equals dropping the normalized
  weights."""
  torch.manual_seed(0)
  attn = layers.MultiHeadAttention(16, 2, 8, 16, dropout_rate=0.5)
  attn.init_weights(torch.Generator().manual_seed(1))
  x = torch.randn(2, 5, 16)
  kv = torch.randn(2, 7, 16)
  mask = torch.rand(2, 7) > 0.3
  got = attn(x, kv, kv_mask=mask, generator=torch.Generator().manual_seed(3))
  keep = (torch.rand(2, 2, 7, generator=torch.Generator().manual_seed(3))
          < 0.5).float() / 0.5
  q, k, v = attn.query(x), attn.key(kv), attn.value(kv)
  scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + (
      (mask.float() - 1) * 1e10)[:, None, None, :]
  weights = torch.softmax(scores, dim=-1) * keep[:, :, None, :]
  want = attn.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))
  np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                             rtol=1e-5, atol=1e-6)
  with torch.no_grad():  # serving: no generator, no dropout
    plain = attn(x, kv, kv_mask=mask)
  assert not torch.allclose(plain, got)


def test_network_dropout_only_with_a_generator():
  module = network.ContextTransformer(config.network_config(
      "tiny", with_context=True, vocab_size=256, dropout_rate=0.1))
  module.init_weights(torch.Generator().manual_seed(0))
  b = {k: torch.from_numpy(v) for k, v in _batch().items()}
  args = (b["encoder_input_tokens"], b["encoder_continuous_inputs"],
          b["encoder_continuous_mask"], b["decoder_target_tokens"],
          torch.tensor([0.3, 0.7, 0.1, 0.9]))
  with torch.no_grad():
    a, again = module(*args), module(*args)
    dropped = module(*args, generator=torch.Generator().manual_seed(5))
    same = module(*args, generator=torch.Generator().manual_seed(5))
  assert torch.equal(a, again) and torch.equal(dropped, same)
  assert not torch.allclose(a, dropped)


def _record_routes(monkeypatch):
  """Counts of MultiHeadAttention's calls of each attention entry."""
  routes = {"flash_attention": 0, "flash_attention_diff": 0}
  for name in routes:
    original = getattr(layers.attention, name)

    def recorded(*args, _name=name, _original=original, **kwargs):
      routes[_name] += 1
      return _original(*args, **kwargs)
    monkeypatch.setattr(layers.attention, name, recorded)
  return routes


def _attention_calls(experiment) -> int:
  """One forward's attention calls: each encoder layer's self-attention
  (token and context encoders) and each decoder layer's self- and
  cross-attention."""
  net = experiment.network()
  return 2 * net.num_encoder_layers + 2 * net.num_decoder_layers


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "int8"])
def test_serving_module_serves_in_grad_mode(compute_dtype, monkeypatch):
  """A frozen serving module called with grad mode on goes to
  flash_attention, the kernel that serves bf16 and int8 on the card (the
  backward kernel takes float32 only), and records no graph."""
  routes = _record_routes(monkeypatch)
  calls = _attention_calls(_tiny_experiment())
  served = inference.build_model(_tiny_experiment(), seed=0, device="cpu",
                                 compute_dtype=compute_dtype)
  batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
  assert torch.is_grad_enabled()
  encodings = served.encode(batch)
  out = served.module.decode(encodings, batch["decoder_target_tokens"],
                             torch.full((4,), 0.5))
  assert out.shape == (4, 16, 128) and torch.isfinite(out.float()).all()
  assert not out.requires_grad
  assert routes == {"flash_attention": calls, "flash_attention_diff": 0}


def test_training_module_routes_to_the_differentiable_attention(
    monkeypatch):
  routes = _record_routes(monkeypatch)
  calls = _attention_calls(_tiny_experiment())
  trained = trainer.build_model(_tiny_experiment(), seed=0, device="cpu")
  batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
  args = (batch["encoder_input_tokens"],
          batch["encoder_continuous_inputs"],
          batch["encoder_continuous_mask"], batch["decoder_target_tokens"],
          torch.full((4,), 0.5))
  assert trained.module(*args).requires_grad
  assert routes == {"flash_attention": 0, "flash_attention_diff": calls}
  with torch.no_grad():
    trained.module(*args)
  assert routes == {"flash_attention": calls, "flash_attention_diff": calls}


# ---------------------------------------------------------------------------
# Data, resume and the CLI.
# ---------------------------------------------------------------------------


def _jax_task():
  return jax_tasks.Task(
      name="tiny",
      source_fn=lambda: jax_synthetic.synthetic_source(3, duration=3.0),
      audio_codec=jax_codecs.MelGan(),
      vocab_config=vocabularies.VocabularyConfig(num_velocity_bins=1),
      note_rep=jax_tasks.NoteRepresentationConfig(include_ties=True))


def _port_task():
  return tasks.Task(
      name="tiny",
      source_fn=lambda: synthetic.synthetic_source(3, duration=3.0),
      audio_codec=codecs.MelGan(),
      vocab_config=vocabularies.VocabularyConfig(num_velocity_bins=1),
      note_rep=tasks.NoteRepresentationConfig(include_ties=True))


def test_synthetic_batches_equal_jax():
  want = iter(_jax_task().model_dataset(LENGTHS, training=True, seed=7)
              .repeat().batch(2))
  got = iter(_port_task().model_dataset(LENGTHS, seed=7).repeat().batch(2))
  for _ in range(3):  # past the first epoch of 3 songs
    w, g = next(want), next(got)
    assert set(w) == set(g)
    for k in w:
      np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _tiny_experiment(**train):
  return dataclasses.replace(
      config.preset("context_tiny"),
      task_lengths=config.TaskLengths(inputs=64, targets=16,
                                      targets_context=16),
      train=config.TrainConfig(batch_size=2, learning_rate=1e-3,
                               warmup_steps=2, checkpoint_period=2, **train))


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
  """2 steps, a checkpoint, a fresh trainer resumed from it and 2 more
  steps on the continuation of the stream == 4 steps straight through,
  bit for bit on the CPU (dropout on, seeded from (seed, step))."""
  experiment = _tiny_experiment(train_steps=4)
  batches = list(_port_task().model_dataset(LENGTHS, seed=0)
                 .repeat().batch(2).take(4))

  def fresh(model_dir):
    t = trainer.Trainer(trainer.build_model(experiment, seed=0,
                                            device="cpu"), experiment.train)
    return t, loop.TrainLoop(trainer=t, experiment=experiment,
                             model_dir=str(model_dir), log_period=1)

  t_a, loop_a = fresh(tmp_path / "a")
  state_a = loop_a.run(iter(batches), t_a.create_state(), seed=1)

  t_b, loop_b = fresh(tmp_path / "b")
  it = iter(batches)
  loop_b.run(it, t_b.create_state(), num_steps=2, seed=1)
  t_c, loop_c = fresh(tmp_path / "b")
  state_c = loop_c.maybe_resume(t_c.create_state())
  assert state_c.step == 2
  state_c = loop_c.run(it, state_c, num_steps=4, seed=1)

  assert state_a.step == state_c.step == 4
  for name, p in t_a.params.items():
    assert torch.equal(p, t_c.params[name]), name
  assert state_a.opt_state["count"] == state_c.opt_state["count"] == 4
  for key in ("v_row", "v_col", "v"):
    for name, v in state_a.opt_state[key].items():
      assert torch.equal(v, state_c.opt_state[key][name]), (key, name)
  logged = [json.loads(l) for l in open(tmp_path / "a" / "metrics.jsonl")]
  resumed = [json.loads(l) for l in open(tmp_path / "b" / "metrics.jsonl")]
  assert [m["loss"] for m in logged] == [m["loss"] for m in resumed]


def test_a_save_cut_short_is_skipped(tmp_path, monkeypatch):
  """A save cut off before its state is in place leaves a directory that
  latest_checkpoint skips; one it takes always has its step."""
  params = {"w": torch.arange(4.0)}
  checkpoints.save_checkpoint(str(tmp_path), 2, params, config_json="{}")

  def cut(*args, **kwargs):
    raise OSError("disk full")
  monkeypatch.setattr(torch, "save", cut)
  with pytest.raises(OSError):
    checkpoints.save_checkpoint(str(tmp_path), 4, params, config_json="{}")
  assert (tmp_path / "step_4").is_dir()
  assert checkpoints.latest_checkpoint(str(tmp_path)) == str(
      tmp_path / "step_2")
  restored = checkpoints.restore_checkpoint(str(tmp_path))
  assert restored["step"] == 2 and restored["config_json"] == "{}"
  assert torch.equal(restored["params"]["w"], params["w"])


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
  argv = ["--synthetic", "--preset", "context_tiny", "--model_dir",
          str(tmp_path), "--batch", "2", "--synthetic_examples", "2",
          "--log_period", "1", "--device", "cpu"]
  state, t = train_cli.main(argv + ["--steps", "2"])
  assert state.step == 2
  lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
  assert [m["step"] for m in lines] == [1, 2]
  for m in lines:
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert m["timing/seconds_per_step"] > 0
  meta = json.load(open(tmp_path / "step_2" / "METADATA"))
  assert meta == {"step": 2, "has_opt_state": True}
  saved = config.ExperimentConfig.from_json(
      open(tmp_path / "step_2" / "config.json").read())
  assert saved.train.batch_size == 2 and saved.size == "tiny"
  state, t = train_cli.main(argv + ["--steps", "3"])
  assert state.step == 3
  assert "resumed from" in capsys.readouterr().out
  # The checkpoint serves: InferenceModel takes its experiment and weights.
  served = inference.load_checkpoint(str(tmp_path), device="cpu")
  assert served.experiment.train.batch_size == 2
  trained = t.model.module.state_dict()
  for name, tensor in served.model.module.state_dict().items():
    assert torch.equal(tensor, trained[name]), name


# --cache_root, --remat and --eval_batches are ported: the CLI runs with
# them in tests/test_torch_train_bf16.py
# test_cli_trains_with_remat_eval_and_cache; --dataset and --data_root in
# tests/test_torch_data_cli.py; --mesh and --distributed over spawned
# ranks in tests/test_torch_parallel.py.
@pytest.mark.parametrize("flags,want", [
    ([], dict(mesh=None, distributed=False, coordinator=None,
              num_processes=None, process_id=None)),
    (["--mesh", "4x2", "--distributed", "--coordinator", "host0:1234",
      "--num_processes", "8", "--process_id", "3"],
     dict(mesh="4x2", distributed=True, coordinator="host0:1234",
          num_processes=8, process_id=3))])
def test_cli_takes_the_jax_parallel_flags(flags, want, tmp_path):
  """--mesh, --distributed, --coordinator, --num_processes and
  --process_id parse with JAX's defaults."""
  argv = ["--preset", "context_tiny", "--model_dir", str(tmp_path),
          "--device", "cpu", "--synthetic"]
  args = vars(train_cli.parse_args(argv + flags))
  assert {k: args[k] for k in want} == want


@pytest.mark.parametrize("mesh", ["4", "2x", "0x1", "axb"])
def test_cli_refuses_a_malformed_mesh(mesh, tmp_path):
  argv = ["--preset", "context_tiny", "--model_dir", str(tmp_path),
          "--device", "cpu", "--synthetic", "--mesh", mesh]
  with pytest.raises(SystemExit):
    train_cli.parse_args(argv)


def test_cli_refuses_a_mesh_of_other_processes(tmp_path):
  """One process and a 4x2 mesh: JAX's make_mesh error."""
  argv = ["--preset", "context_tiny", "--model_dir", str(tmp_path),
          "--device", "cpu", "--synthetic", "--mesh", "4x2"]
  with pytest.raises(ValueError, match="mesh 4x2 != 1 devices"):
    train_cli.main(argv)


def test_cli_takes_the_jax_dataset_flags(tmp_path):
  """--dataset (default maestrov3, as JAX's), --data_root and mega parse;
  --synthetic is no longer required (the CLI runs them in
  tests/test_torch_data_cli.py)."""
  argv = ["--preset", "context_tiny", "--model_dir", str(tmp_path)]
  args = train_cli.parse_args(argv)
  assert (args.dataset, args.data_root, args.synthetic) == (
      "maestrov3", None, False)
  args = train_cli.parse_args(argv + ["--dataset", "mega", "--data_root",
                                      str(tmp_path)])
  assert (args.dataset, args.data_root) == ("mega", str(tmp_path))


def test_cli_refuses_an_unknown_dataset_as_jax(tmp_path, capsys):
  """An unknown name is JAX's usage error (p.error, exit code 2)."""
  argv = ["--preset", "context_tiny", "--model_dir", str(tmp_path)]
  with pytest.raises(SystemExit) as e:
    train_cli.parse_args(argv + ["--dataset", "maestro"])
  assert e.value.code == 2
  assert "unknown dataset 'maestro'" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The notes-only and autoregressive families, and the data flags.
# ---------------------------------------------------------------------------


def test_notes_only_batches_equal_jax():
  """The task without context (notes-only and autoregressive models):
  chunks without context frames, and the teacher-forcing shift."""
  lengths = {"inputs": 64, "targets": 16}
  jt, pt = _jax_task(), _port_task()
  jt.with_context = pt.with_context = False
  want = iter(jt.model_dataset(lengths, training=True, seed=7).repeat()
              .batch(2))
  got = iter(pt.model_dataset(lengths, seed=7).repeat().batch(2))
  for _ in range(3):
    w, g = next(want), next(got)
    assert set(g) == set(w) == {"encoder_input_tokens",
                                "decoder_target_tokens",
                                "decoder_input_tokens", "decoder_target_mask"}
    for k in w:
      np.testing.assert_array_equal(g[k], w[k], err_msg=k)
  np.testing.assert_array_equal(g["decoder_input_tokens"][:, 1:],
                                g["decoder_target_tokens"][:, :-1])


@pytest.mark.parametrize("preset,family", [
    ("diffusion_tiny", model.DiffusionModel),
    ("ar_tiny", ar_model.AutoregressiveModel)])
def test_cli_trains_each_family_on_the_cpu(preset, family, tmp_path):
  state, t = train_cli.main([
      "--synthetic", "--preset", preset, "--model_dir", str(tmp_path),
      "--batch", "2", "--synthetic_examples", "2", "--log_period", "1",
      "--steps", "2", "--device", "cpu"])
  assert state.step == 2 and isinstance(t.model, family)
  lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
  assert [m["step"] for m in lines] == [1, 2]
  for m in lines:
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
  served = inference.load_checkpoint(str(tmp_path), device="cpu")
  assert isinstance(served.model, family)


def test_cli_takes_the_jax_data_flags(tmp_path, monkeypatch):
  """A JAX command line with --shuffle_buffer and --data_threads parses
  and its values reach model_dataset."""
  argv = ["--synthetic", "--preset", "context_tiny", "--model_dir",
          str(tmp_path), "--shuffle_buffer", "0", "--data_threads", "1"]
  args = train_cli.parse_args(argv + ["--device", "cpu"])
  assert (args.shuffle_buffer, args.data_threads) == (0, 1)
  defaults = train_cli.parse_args(argv[:5])
  assert (defaults.shuffle_buffer, defaults.data_threads) == (256, 8)
  seen = []

  class Reached(Exception):
    pass

  def model_dataset(self, lengths, seed=0, shuffle_buffer_size=256,
                    num_threads=1):
    seen.append((shuffle_buffer_size, num_threads))
    raise Reached

  monkeypatch.setattr(tasks.Task, "model_dataset", model_dataset)
  with pytest.raises(Reached):
    train_cli.main(argv + ["--device", "cpu"])
  assert seen == [(0, 1)]
