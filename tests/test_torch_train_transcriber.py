"""cli/train_transcriber.py of the port against the JAX CLI's.

* Training steps, augmentation off (as `--input_noise 0 --time_masks 0
  --freq_masks 0 --gain_jitter 0`), held against JAX's step on the same
  params and batches: the JAX CLI's loss function, `optax.adamw(weight
  decay 1e-4)` under `warmup_cosine_decay_schedule(0, lr, warmup,
  max(steps, warmup + 1))`, specs stored as bf16 and cast back. Tolerances:
  the schedule's learning rates exactly (float32 in both); loss within
  1e-6 relative and accuracy exactly, every step; after 3 steps every
  parameter within 1e-6 of JAX's, except at most 1e-4 of the elements,
  which stay within 2 x lr x steps (Adam's update divides a near-zero
  gradient by its own magnitude, so there a gradient's last bits decide
  the update's sign).
* `--gen_only --data_cache`: the `.npz` byte for byte the JAX CLI's.
* The CLI on the CPU: 2 steps, a checkpoint, a resumed third step; the
  augmentation seeded per step.
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.cli import train_transcriber
from music_spectrogram_diffusion_tpu_torch.infer import mt3

GEOMETRY = dict(emb_dim=64, num_heads=2, head_dim=64, num_encoder_layers=1,
                num_decoder_layers=1, mlp_dim=64)
VOCAB = 1536


@pytest.mark.parametrize("warmup,steps", [(0, 3), (2, 5), (200, 2000)])
def test_lr_schedule_equals_optax(warmup, steps):
  import optax
  decay = max(steps, warmup + 1)
  want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, decay)
  got = train_transcriber.lr_schedule(1e-3, warmup, decay)
  for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2,
                       steps - 1, steps, steps + 5} - {-1}):
    assert got(count) == float(want(count)), count


def test_train_steps_match_jax():
  import jax
  import jax.numpy as jnp
  import ml_dtypes
  import optax
  from music_spectrogram_diffusion_tpu.infer import mt3 as jax_mt3

  module = jax_mt3.MT3Transformer(config=jax_mt3.MT3Config(
      vocab_size=VOCAB, **GEOMETRY))
  rng = np.random.RandomState(0)
  specs = rng.randn(6, 256, 512).astype(np.float32)
  targets = rng.randint(2, VOCAB, (6, 32)).astype(np.int32)
  targets[:, 20:] = 0
  params = module.init(jax.random.PRNGKey(0), specs[:1],
                       np.ones((1, 256), bool), targets[:1],
                       targets[:1])["params"]
  lr, steps, warmup = 1e-3, 3, 0
  tx = optax.adamw(optax.warmup_cosine_decay_schedule(
      0.0, lr, warmup, max(steps, warmup + 1)), weight_decay=1e-4)

  # The JAX CLI's loss and step (cli/train_transcriber.py), augmentation
  # off.
  def loss_fn(params, spec_b, tgt_b):
    mask = jnp.ones(spec_b.shape[:2], bool)
    inputs = jnp.pad(tgt_b, ((0, 0), (1, 0)))[:, :-1]
    logits = module.apply({"params": params}, spec_b, mask, inputs, tgt_b)
    weights = (tgt_b > 0).astype(jnp.float32)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt_b)
    loss = jnp.sum(ce * weights) / jnp.maximum(jnp.sum(weights), 1.0)
    acc = jnp.sum((jnp.argmax(logits, -1) == tgt_b) * weights) / (
        jnp.maximum(jnp.sum(weights), 1.0))
    return loss, acc

  spec_all = jnp.asarray(specs.astype(ml_dtypes.bfloat16))

  @jax.jit
  def jax_step(params, opt_state, idx):
    spec_b = jnp.take(spec_all, idx, axis=0).astype(jnp.float32)
    tgt_b = jnp.take(jnp.asarray(targets), idx, axis=0)
    (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, spec_b, tgt_b)
    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, acc

  port = mt3.MT3Transformer(mt3.MT3Config(vocab_size=VOCAB, **GEOMETRY))
  port.load_state_dict(convert.flax_to_state_dict(
      jax.tree_util.tree_map(np.asarray, params), port), strict=True)
  opt = train_transcriber.AdamW(train_transcriber.lr_schedule(
      lr, warmup, max(steps, warmup + 1)), weight_decay=1e-4)
  opt_state = opt.init(dict(port.named_parameters()))
  specs_dev = torch.as_tensor(specs).to(torch.bfloat16)
  jax_state = tx.init(params)
  args = argparse.Namespace()
  for step in range(steps):
    idx = np.array([step, step + 2, (step + 4) % 6])
    params, jax_state, jax_loss, jax_acc = jax_step(params, jax_state,
                                                    jnp.asarray(idx))
    opt_state, loss, acc = train_transcriber.train_step(
        port, opt, opt_state, specs_dev, torch.as_tensor(targets),
        torch.as_tensor(idx), args, None)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-6)
    assert float(acc) == float(jax_acc)
  assert opt_state["count"] == steps
  want = convert.flax_to_state_dict(
      jax.tree_util.tree_map(np.asarray, params), port)
  off, total = 0, 0
  for name, value in port.state_dict().items():
    diff = (want[name] - value).abs()
    assert float(diff.max()) <= 2 * lr * steps, name
    off += int((diff > 1e-6).sum())
    total += diff.numel()
  assert off <= 1e-4 * total, (off, total)


def _jax_cli(argv, monkeypatch):
  from music_spectrogram_diffusion_tpu.cli import train_transcriber as jax_cli
  monkeypatch.setattr(sys, "argv", ["train_transcriber"] + argv)
  jax_cli.main()


def test_data_cache_is_byte_identical(tmp_path, monkeypatch):
  common = ["--synthetic_examples", "3", "--song_seconds", "4.0",
            "--max_tokens", "256", "--seed", "3", "--gen_only"]
  _jax_cli(["--model_dir", str(tmp_path / "j"), "--data_cache",
            str(tmp_path / "jax.npz")] + common, monkeypatch)
  train_transcriber.main(["--model_dir", str(tmp_path / "p"),
                          "--data_cache", str(tmp_path / "port.npz")]
                         + common)
  jax_bytes = (tmp_path / "jax.npz").read_bytes()
  assert len(jax_bytes) > 1_000_000
  assert (tmp_path / "port.npz").read_bytes() == jax_bytes


def test_cli_trains_and_resumes(tmp_path, capsys):
  model_dir = str(tmp_path / "run")
  argv = ["--model_dir", model_dir, "--synthetic_examples", "3",
          "--song_seconds", "3.0", "--batch", "2", "--log_period", "1",
          "--checkpoint_period", "2", "--emb_dim", "64", "--num_layers",
          "1", "--num_heads", "2", "--mlp_dim", "64", "--max_tokens", "128",
          "--data_cache", str(tmp_path / "data.npz"), "--device", "cpu"]
  first = train_transcriber.main(argv + ["--steps", "2"])
  assert np.isfinite(first["loss"]) and np.isfinite(first["eval_loss"])
  assert os.path.isdir(os.path.join(model_dir, "step_2"))
  capsys.readouterr()
  second = train_transcriber.main(argv + ["--steps", "3"])
  out = capsys.readouterr().out
  assert "loaded" in out and "resumed from" in out and "next step 3" in out
  assert np.isfinite(second["loss"])
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints
  restored = checkpoints.restore_checkpoint(model_dir)
  assert restored["step"] == 3 and restored["opt_state"]["count"] == 3
  assert '"kind": "mt3_transcriber"' in restored["config_json"]
  assert train_transcriber.main(argv + ["--steps", "3"]) == {}
  assert "nothing to do" in capsys.readouterr().out


def test_augment_draws_from_its_generator():
  """SpecAugment, gain and noise (the JAX CLI's order and bounds) from a
  generator seeded per step: the same seed gives the same batch, another
  step another; what the masks change is the example's mean."""
  args = argparse.Namespace(time_masks=2, time_mask_width=48, freq_masks=2,
                            freq_mask_width=24, gain_jitter=0.0,
                            input_noise=0.0)
  spec = torch.randn(3, 256, 512)
  a = train_transcriber.augment(
      args, spec, train_transcriber.step_generator(2, 5, "cpu"))
  b = train_transcriber.augment(
      args, spec, train_transcriber.step_generator(2, 5, "cpu"))
  c = train_transcriber.augment(
      args, spec, train_transcriber.step_generator(2, 6, "cpu"))
  assert torch.equal(a, b) and not torch.equal(a, c)
  fill = spec.mean(dim=(1, 2), keepdim=True).expand_as(spec)
  changed = a != spec
  assert torch.equal(a[changed], fill[changed])
  args.gain_jitter, args.input_noise = 0.5, 0.5
  noisy = train_transcriber.augment(
      args, spec, train_transcriber.step_generator(2, 5, "cpu"))
  assert noisy.shape == spec.shape and bool(torch.isfinite(noisy).all())
