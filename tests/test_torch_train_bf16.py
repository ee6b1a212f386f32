"""bf16 training, remat, the held-out eval pass and the training CLI's
remat, eval and cache flags, against the JAX package at tiny size.

bf16 against JAX: JAX's `value_and_grad` of `loss_fn` in bf16, with every
attention through its Pallas kernels (interpret mode, mxu_bf16) and a real
key (its draws are handed to the port), against the port's bf16 step (the
kernels' plain versions on the CPU). The loss is held to 1e-2 relative.
Each gradient is held, as max |diff| over its max and as relative RMS, to
2.5% and 2%, or to twice JAX's own bf16 error on that gradient (its
distance from the float32 gradient), whichever is larger: two bf16 steps
that round in other places differ by about bf16's own error, which here
reaches 3.3% / 2.2% (largest over the gradients). The step takes an L2
loss: with the presets' L1 loss, whose sign turns a one-ulp change of a
prediction into a full gradient term, JAX's own bf16 error is 8.2% / 6.7%.
The float32 gradient is the port's float32 step, which equals JAX's to
3e-4 (tests/test_torch_train.py). tools/bf16_step_noise.py measures these
gaps for both losses.

remat: on and off give the same loss and gradients bit for bit, dropout
included, and remat matches the JAX package's remat=True in float32 at
tests/test_torch_train.py's tolerances.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.models import layers as jax_layers
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.cli import train as train_cli
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model, network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d
from music_spectrogram_diffusion_tpu_torch.train import loop, trainer

LOSS_REL = 1e-2
GRAD_MAX, GRAD_RMS = 0.025, 0.02


def _batch(rows=2):
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
  batch["encoder_input_tokens"][-1, 10:] = 0
  batch["encoder_continuous_mask"][0, 9:] = False
  return batch


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _injected(eps, time, include):
  arrays = [torch.from_numpy(np.array(x)) for x in (eps, time, include)]
  return lambda x0, cfg: tuple(arrays)


def _port_step(params, dtype, diffusion, draws, remat=False):
  """(loss, {flax path: gradient}) of the port's step from JAX's params."""
  module = network.ContextTransformer(config.network_config(
      "tiny", with_context=True, vocab_size=256, dropout_rate=0.0,
      dtype=dtype, remat=remat))
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  assert all(p.dtype == torch.float32 for p in module.parameters())
  pm = model.ContextDiffusionModel(module, diffusion, codecs.MelGan())
  loss, _ = pm.loss_fn(_torch_batch(_batch()), draws)
  loss.backward()
  named = dict(module.named_parameters())
  grads = {}
  for path in convert.flatten(jax.tree.map(np.asarray, params)):
    p = named[convert.torch_name(path)]
    if p.requires_grad:
      assert p.grad.dtype == torch.float32
      grads[path] = p.grad.numpy()
  return loss.item(), grads


def _gaps(got, want):
  """Per gradient: (max |diff| / max |want|, relative RMS)."""
  out = {}
  for path, g in got.items():
    w = np.asarray(want[path], np.float32).reshape(g.shape)
    scale = np.abs(w).max()
    if scale > 0:
      out[path] = (np.abs(g - w).max() / scale,
                   np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)))
  return out


def test_bf16_step_matches_jax(monkeypatch):
  monkeypatch.setattr(jax_layers, "FLASH_MIN_SCORE_BYTES", 0)
  batch = _batch()
  jcfg = jd.DiffusionConfig(loss_norm="l2")
  jm = jax_model.ContextDiffusionModel(
      jax_network.ContextTransformer(config=jax_config.network_config(
          "tiny", with_context=True, vocab_size=256, dropout_rate=0.0,
          dtype="bfloat16")), jcfg, jax_codecs.MelGan())
  params = jax.jit(lambda key: jm.init_variables(
      key, {k: v.shape for k, v in batch.items()},
      {k: v.dtype for k, v in batch.items()}))(
          jax.random.PRNGKey(0))["params"]
  key = jax.random.PRNGKey(3)
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  (loss, _), grads = jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, key), has_aux=True)(params)
  jax_grads = {k: np.asarray(v, np.float32) for k, v in
               convert.flatten(jax.tree.map(np.asarray, grads)).items()}
  targets = jm.audio_codec.scale_features(
      jb["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  _, eps, time, include = jd.training_input(jax.random.split(key)[1],
                                            targets, jcfg)
  draws = _injected(eps, time, include)
  tcfg = d.DiffusionConfig(loss_norm="l2")
  got_loss, got = _port_step(params, "bfloat16", tcfg, draws)
  _, f32 = _port_step(params, "float32", tcfg, draws)

  assert abs(got_loss - float(loss)) <= LOSS_REL * abs(float(loss))
  assert set(got) <= set(jax_grads)
  own = _gaps({k: jax_grads[k].reshape(v.shape) for k, v in got.items()},
              f32)
  for name, gaps in (("port vs JAX bf16", _gaps(got, jax_grads)),
                     ("port bf16 vs float32", _gaps(got, f32))):
    for path, (gap_max, gap_rms) in gaps.items():
      assert gap_max <= max(GRAD_MAX, 2 * own[path][0]), (name, path, gap_max)
      assert gap_rms <= max(GRAD_RMS, 2 * own[path][1]), (name, path, gap_rms)


def _tiny_experiment(dtype="float32", remat=False, dropout=0.1, **train):
  return dataclasses.replace(
      config.preset("context_tiny"), dtype=dtype, remat=remat,
      dropout_rate=dropout,
      task_lengths=config.TaskLengths(inputs=64, targets=16,
                                      targets_context=16),
      train=config.TrainConfig(batch_size=2, learning_rate=1e-3,
                               warmup_steps=2, checkpoint_period=2, **train))


def _step(experiment, seed=0):
  """(loss, gradients, the dropout generator's end state) of one step with
  dropout, from weights and generators fixed by `seed`."""
  t = trainer.Trainer(trainer.build_model(experiment, seed=seed,
                                          device="cpu"), experiment.train)
  draws_gen, dropout_gen = trainer.step_generators(seed, 0, "cpu")
  metrics, grads = t.loss_and_grads(_torch_batch(_batch()),
                                    d.generator_draws(draws_gen),
                                    dropout_gen)
  return metrics["loss"], grads, dropout_gen.get_state()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_on_and_off_are_bit_equal(dtype):
  """Dropout 0.1 from one generator: the same masks with remat on and off,
  in the first run and in the rerun of each layer."""
  loss_on, grads_on, end_on = _step(_tiny_experiment(dtype, remat=True))
  loss_off, grads_off, end_off = _step(_tiny_experiment(dtype, remat=False))
  assert torch.equal(loss_on, loss_off)
  assert torch.equal(end_on, end_off)
  assert set(grads_on) == set(grads_off)
  for name, g in grads_on.items():
    assert torch.equal(g, grads_off[name]), name
  # Dropout was on: another generator gives another loss.
  other, _, _ = _step(_tiny_experiment(dtype, remat=True), seed=1)
  assert not torch.equal(other, loss_on)


def test_remat_reruns_each_layer(monkeypatch):
  """In grad mode every encoder and decoder layer goes through checkpoint;
  without grad mode (serving) none does."""
  calls = []
  wrapped = network.checkpoint.checkpoint

  def counted(*args, **kwargs):
    calls.append(kwargs.get("use_reentrant"))
    return wrapped(*args, **kwargs)

  monkeypatch.setattr(network.checkpoint, "checkpoint", counted)
  experiment = _tiny_experiment(remat=True)
  _step(experiment)
  net = experiment.network()
  assert calls == [False] * (2 * net.num_encoder_layers
                             + net.num_decoder_layers)
  calls.clear()
  m = trainer.build_model(experiment, seed=0, device="cpu")
  with torch.no_grad():
    m.loss_fn(_torch_batch(_batch()),
              d.generator_draws(torch.Generator().manual_seed(0)))
  assert calls == []


def test_remat_matches_jax_remat():
  """float32, remat=True on both sides, at tests/test_torch_train.py's
  tolerances (loss 1e-5 relative, each gradient 3e-4 of its max)."""
  batch = _batch()
  jcfg = jd.DiffusionConfig()
  jm = jax_model.ContextDiffusionModel(
      jax_network.ContextTransformer(config=jax_config.network_config(
          "tiny", with_context=True, vocab_size=256, dropout_rate=0.0,
          remat=True)), jcfg, jax_codecs.MelGan())
  params = jax.jit(lambda key: jm.init_variables(
      key, {k: v.shape for k, v in batch.items()},
      {k: v.dtype for k, v in batch.items()}))(
          jax.random.PRNGKey(0))["params"]
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  (loss, _), grads = jax.jit(jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, None), has_aux=True))(params)
  targets = jm.audio_codec.scale_features(
      jb["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  _, eps, time, include = jd.training_input(
      jax.random.split(jax.random.PRNGKey(0))[1], targets, jcfg)
  got_loss, got = _port_step(params, "float32", d.DiffusionConfig(),
                             _injected(eps, time, include), remat=True)
  np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
  flat = convert.flatten(jax.tree.map(np.asarray, grads))
  for path, g in got.items():
    want = np.asarray(flat[path]).reshape(g.shape)
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=3e-4 * np.abs(want).max() + 1e-8,
                               err_msg=path)


def test_bf16_model_keeps_f32_params_and_computes_in_bf16():
  experiment = _tiny_experiment("bfloat16", remat=True)
  t = trainer.Trainer(trainer.build_model(experiment, seed=0, device="cpu"),
                      experiment.train)
  module = t.model.module
  assert all(p.dtype == torch.float32 for p in module.parameters())
  batch = _torch_batch(_batch())
  encodings = module.encode(batch["encoder_input_tokens"],
                            batch["encoder_continuous_inputs"],
                            batch["encoder_continuous_mask"])
  assert all(e.dtype == torch.bfloat16 for e, _ in encodings)
  before = {n: p.detach().clone() for n, p in t.params.items()}
  state, metrics = t.train_step(t.create_state(), _batch(), seed=0)
  assert state.step == 1 and np.isfinite(metrics["loss"].item())
  assert np.isfinite(metrics["grad_norm"].item())
  for n, p in t.params.items():
    assert p.dtype == torch.float32 and torch.isfinite(p).all()
  assert any(not torch.equal(p, before[n]) for n, p in t.params.items())


def test_eval_step_is_deterministic():
  """No dropout and the same draws at every call (JAX's loss_fn with
  dropout_rng=None): two calls give the same metrics, equal to loss_fn
  with the draws of a generator seeded EVAL_DRAWS_SEED and no dropout."""
  experiment = _tiny_experiment()
  t = trainer.Trainer(trainer.build_model(experiment, seed=0, device="cpu"),
                      experiment.train)
  first, second = t.eval_step(_batch()), t.eval_step(_batch())
  assert set(first) >= {"loss", "loss_per_frame", "n_frames", "n_seqs"}
  for k in first:
    assert not first[k].requires_grad
    assert torch.equal(first[k], second[k]), k
  _, want = t.model.loss_fn(_torch_batch(_batch()), d.generator_draws(
      torch.Generator().manual_seed(trainer.EVAL_DRAWS_SEED)))
  assert torch.equal(first["loss"], want["loss"].detach())
  # A train step's dropout and draws give another loss.
  _, train_metrics = t.train_step(t.create_state(), _batch(), seed=0)
  assert not torch.equal(train_metrics["loss"], first["loss"])


def test_train_loop_logs_the_eval_pass(tmp_path):
  experiment = _tiny_experiment(train_steps=4, eval_period=2)
  t = trainer.Trainer(trainer.build_model(experiment, seed=0, device="cpu"),
                      experiment.train)
  states = []

  def eval_fn(state):
    states.append(state.step)
    return {k: float(v) for k, v in t.eval_step(_batch()).items()}

  runner = loop.TrainLoop(trainer=t, experiment=experiment,
                          model_dir=str(tmp_path), log_period=1,
                          eval_fn=eval_fn)
  runner.run(iter([_batch()] * 4), t.create_state(), seed=1)
  assert states == [2, 4]
  lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
  evals = [m for m in lines if "eval/loss" in m]
  assert [m["step"] for m in evals] == [2, 4]
  for m in evals:
    assert set(m) == {"step", "eval/loss", "eval/loss_per_frame",
                      "eval/n_frames", "eval/n_seqs", "eval/context_frames"}
    assert np.isfinite(m["eval/loss"])
  assert [m["step"] for m in lines if "loss" in m] == [1, 2, 3, 4]


def test_bf16_checkpoint_serves(tmp_path):
  """A checkpoint trained in bf16 (config.json says bfloat16, the
  parameters are float32) serves through load_checkpoint."""
  experiment = _tiny_experiment("bfloat16", remat=True, train_steps=1)
  t = trainer.Trainer(trainer.build_model(experiment, seed=0, device="cpu"),
                      experiment.train)
  loop.TrainLoop(trainer=t, experiment=experiment, model_dir=str(tmp_path),
                 log_period=1).run(iter([_batch()]), t.create_state(), seed=1)
  served = inference.load_checkpoint(str(tmp_path), device="cpu")
  assert served.experiment.dtype == "bfloat16" and served.experiment.remat
  assert served.step == 1
  trained = t.model.module.state_dict()
  for name, tensor in served.model.module.state_dict().items():
    assert torch.equal(tensor.float(),
                       trained[name].to(tensor.dtype).float()), name
  batch = _batch(1)
  out = served.predict({k: v for k, v in batch.items()
                        if k != "decoder_target_mask"}, seed=0)
  assert out.shape == batch["decoder_target_tokens"].shape
  assert np.isfinite(out).all()


def test_cli_trains_with_remat_eval_and_cache(tmp_path, capsys):
  cache_root = tmp_path / "cache"
  argv = ["--synthetic", "--preset", "context_tiny", "--model_dir",
          str(tmp_path / "run"), "--batch", "2", "--synthetic_examples", "2",
          "--log_period", "1", "--device", "cpu", "--remat",
          "--eval_batches", "2", "--eval_period", "2", "--cache_root",
          str(cache_root)]
  state, t = train_cli.main(argv + ["--steps", "2"])
  assert state.step == 2
  assert t.model.module.config.remat
  out = capsys.readouterr().out
  # The JAX package's cache names: train on seeds [0, 2), eval on 8 songs
  # from seed 1000.
  assert sorted(os.listdir(cache_root)) == ["eval_8ex_s1000_vb1",
                                            "train_2ex_vb1"]
  assert out.count("building synthetic cache") == 2
  lines = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
  evals = [m for m in lines if "eval/loss" in m]
  assert [m["step"] for m in evals] == [2]
  assert np.isfinite(evals[0]["eval/loss"])
  saved = config.ExperimentConfig.from_json(
      open(tmp_path / "run" / "step_2" / "config.json").read())
  assert saved.remat and saved.train.eval_period == 2
  # The rerun reads both caches and resumes.
  state, _ = train_cli.main(argv + ["--steps", "4"])
  assert state.step == 4
  out = capsys.readouterr().out
  assert "building synthetic cache" not in out and "resumed from" in out
  lines = [json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")]
  assert [m["step"] for m in lines if "eval/loss" in m] == [2, 4]
