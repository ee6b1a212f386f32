"""The port's vocoder trainers against the JAX package's optax steps.

Each trainer takes one step from the same weights (the Flax trees mapped
by `convert.flax_convs_to_state_dict`) on the same numpy-seeded batch:
the metrics, every gradient and every updated parameter are compared.
Tolerances: the metrics 1e-5 relative; each gradient within 1e-4 of its
leaf's largest magnitude (float32 convolutions and FFTs summed in other
orders; the discriminator's within 1e-3 relative RMS and 1e-2 of the
largest, for the leaky ReLU's kink, see DISC_GRAD_RMS); each updated
parameter within 1e-4 x the learning rate plus
1e-7 of JAX's (AdamW's first step moves a weight by about lr x sign(g):
equal signs, equal steps), or within 2 x lr where JAX's gradient is within
the gradient tolerance of zero (the sign is rounding's there). `vocoder_batches` gives JAX's audio bit for bit
and its mel within the codec's tolerance of tests/test_torch_stft.py
(1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.audio import (
    discriminators as jax_disc, vocoder as jax_vocoder,
    vocoder_train as jax_train)
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.audio import (
    codecs, discriminators, vocoder, vocoder_train)
from music_spectrogram_diffusion_tpu_torch.train import trainer

METRIC_REL = 1e-5
GRAD_REL = 1e-4
STEP_REL = 1e-4  # of the learning rate
MEL_TOL = 1e-4
# A pre-activation within float32 rounding of a leaky ReLU's kink takes
# slope 1 on one side and 0.2 on the other: in the adversarial test one of
# the STFT discriminator's first-layer pre-activations lies within rounding
# of zero, which moves its channel's bias gradient by 0.9% of its largest
# entry; the other leaves agree far closer.
DISC_GRAD_RMS = 1e-3
DISC_GRAD_MAX = 1e-2


def _batch(frames, rows=2, seed=0):
  r = np.random.RandomState(seed)
  mel = r.uniform(-11, 4, (rows, frames, 128)).astype(np.float32)
  audio = (r.randn(rows, frames * 320) * 0.1).astype(np.float32)
  return mel, audio


def _flat(tree):
  return convert.flatten(jax.tree.map(np.asarray, tree))


def _torch_name(path: str) -> str:
  stem, _, leaf = path.rpartition("/")
  return stem.replace("/", ".") + (".weight" if leaf == "kernel"
                                   else ".bias")


def _as_flax(value: np.ndarray, like: np.ndarray) -> np.ndarray:
  """A torch conv weight (or bias) in the Flax leaf's layout."""
  if value.ndim == 3:
    value = value.transpose(2, 1, 0)
  elif value.ndim == 4:
    value = value.transpose(2, 3, 1, 0)
  assert value.shape == like.shape
  return value


def _check_tree(got: dict, want_tree, rtol, atol_fn, what):
  want = _flat(want_tree)
  assert {_torch_name(p) for p in want} == set(got), what
  for path, w in want.items():
    g = _as_flax(got[_torch_name(path)].detach().cpu().numpy(), w)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_fn(w),
                               err_msg=f"{what} {path}")


def _check_grads(got, want_tree, what):
  _check_tree(got, want_tree, 0, lambda w: GRAD_REL * np.abs(w).max()
              + 1e-12, what)


def _check_disc_grads(got, want_tree, what):
  """The discriminator's gradients: each leaf within DISC_GRAD_RMS
  relative RMS and DISC_GRAD_MAX of its largest magnitude of JAX's."""
  want = _flat(want_tree)
  assert {_torch_name(p) for p in want} == set(got), what
  for path, w in want.items():
    g = _as_flax(got[_torch_name(path)].detach().cpu().numpy(), w)
    # (The last layers' biases get exactly 0 from both hinge terms.)
    rms = np.sqrt(np.mean((g - w) ** 2))
    assert rms <= DISC_GRAD_RMS * np.sqrt(np.mean(w ** 2)) + 1e-9, (
        what, path, rms)
    assert np.abs(g - w).max() <= DISC_GRAD_MAX * np.abs(w).max() + 1e-9, (
        what, path, np.abs(g - w).max())


def _check_params(got, want_tree, lr, grads_tree, what):
  """Each updated weight within STEP_REL x lr of JAX's; where JAX's
  gradient is within the gradient tolerance of zero, AdamW's first step
  (about lr x sign(g)) may go either way, so there within 2 x lr."""
  want, grads = _flat(want_tree), _flat(grads_tree)
  assert {_torch_name(p) for p in want} == set(got), what
  for path, w in want.items():
    g = _as_flax(got[_torch_name(path)].detach().cpu().numpy(), w)
    grad = grads[path]
    near_zero = np.abs(grad) <= GRAD_REL * np.abs(grad).max()
    limit = np.where(near_zero, 2 * lr, STEP_REL * lr) + 1e-7
    bad = np.abs(g - w) > limit
    assert not bad.any(), (f"{what} {path}: {int(bad.sum())} weights off, "
                           f"largest {np.abs(g - w)[bad].max()}")


def _check_metrics(got, want):
  assert set(got) == set(want)
  for k, v in want.items():
    np.testing.assert_allclose(got[k].item(), float(v), rtol=METRIC_REL,
                               atol=1e-9, err_msg=k)


def _moved(before, after):
  return any(not np.array_equal(np.asarray(a), np.asarray(b))
             for a, b in zip(jax.tree_util.tree_leaves(before),
                             jax.tree_util.tree_leaves(after)))


def test_vocoder_trainer_step_matches_optax():
  codec, jcodec = codecs.MelGan(), jax_codecs.MelGan()
  cfg = dict(base_channels=32)
  jt = jax_train.VocoderTrainer(
      jax_vocoder.SoundStreamDecoder(config=jax_vocoder.SoundStreamConfig(
          **cfg)), jcodec, learning_rate=1e-3)
  state = jax.jit(lambda key: jt.create_state(key, mel_frames=8))(
      jax.random.PRNGKey(0))
  params = jax.tree.map(np.array, state.params)  # the step donates state
  mel, audio = _batch(8)
  (_, _), want_g = jax.jit(jax.value_and_grad(jt.loss_fn,
                                                  has_aux=True))(
      params, jnp.asarray(mel), jnp.asarray(audio))
  new_state, want_m = jt.train_step(state, jnp.asarray(mel),
                                    jnp.asarray(audio))

  decoder = vocoder.SoundStreamDecoder(vocoder.SoundStreamConfig(**cfg))
  decoder.load_state_dict(convert.flax_convs_to_state_dict(
      jax.tree.map(np.asarray, params["params"]), decoder))
  pt = vocoder_train.VocoderTrainer(decoder, codec, learning_rate=1e-3,
                                    device="cpu")
  st = pt.create_state(seed=None)
  total, _ = pt.loss_fn(torch.from_numpy(mel), torch.from_numpy(audio))
  _check_grads(vocoder_train._grads(total, st.params), want_g["params"],
               "grad")
  st, got_m = pt.train_step(st, mel, audio)
  assert st.step == 1
  _check_metrics(got_m, want_m)
  assert _moved(params, new_state.params)
  _check_params(st.params, new_state.params["params"], 1e-3,
                want_g["params"], "param")


def test_magnitude_trainer_step_from_the_committed_export_matches_optax():
  params, _, _ = convert.read_export(vocoder.TRAINED_MAGNITUDE_GL)
  codec, jcodec = codecs.MelGan(), jax_codecs.MelGan()
  jt = jax_train.MagnitudeTrainer(jax_vocoder.MagnitudeNet(), jcodec)
  variables = jax.tree.map(np.array, params)
  state = jax_train.VocoderTrainState(
      step=jnp.zeros((), jnp.int32),
      params=jax.tree.map(jnp.array, variables),
      opt_state=jt.optimizer.init(variables))
  # A batch of real mel/audio pairs: broadband audio and its own log-mel
  # (a pure tone's empty bins sit at the loss's 1e-5 magnitude clamp,
  # where float32 rounding decides which side a bin falls).
  audio = (np.random.RandomState(4).randn(2, 16 * 320) * 0.1).astype(
      np.float32)
  mel = np.asarray(jcodec.encode(jnp.asarray(audio)))[:, :16]
  (_, _), want_g = jax.jit(jax.value_and_grad(jt.loss_fn,
                                                  has_aux=True))(
      variables, jnp.asarray(mel), jnp.asarray(audio))
  new_state, want_m = jt.train_step(state, jnp.asarray(mel),
                                    jnp.asarray(audio))

  net = vocoder.MagnitudeNet()
  net.load_state_dict(convert.flax_convs_to_state_dict(params["params"],
                                                       net))
  pt = vocoder_train.MagnitudeTrainer(net, codec, device="cpu")
  st = pt.create_state(seed=None)
  total, _ = pt.loss_fn(torch.from_numpy(mel), torch.from_numpy(audio))
  _check_grads(vocoder_train._grads(total, st.params), want_g["params"],
               "grad")
  st, got_m = pt.train_step(st, mel, audio)
  _check_metrics(got_m, want_m)
  assert _moved(variables, new_state.params)
  _check_params(st.params, new_state.params["params"], 1e-3,
                want_g["params"], "param")


def _jax_g_loss(jt, g_params, d_params, mel, audio):
  """JAX's generator loss of AdversarialVocoderTrainer.train_step, made of
  the JAX package's own pieces (its step keeps the function local)."""
  pred = jt.decoder.apply(g_params, mel)
  n = min(pred.shape[-1], audio.shape[-1])
  pred, target = pred[..., :n], audio[..., :n]
  rec = jax_train.stft_loss(pred, target)
  wav_l1 = jnp.mean(jnp.abs(pred - target))
  fake_out = jt.disc.apply(d_params, pred)
  real_out = jt.disc.apply(d_params, target)
  return (rec["spectral_convergence"] + rec["log_magnitude"]
          + jt.waveform_weight * wav_l1
          + jt.adversarial_weight * jax_disc.hinge_g_loss(fake_out)
          + jt.feature_matching_weight * jax_disc.feature_matching_loss(
              real_out, fake_out))


def _jax_d_loss(jt, d_params, pred, target):
  return jax_disc.hinge_d_loss(jt.disc.apply(d_params, target),
                               jt.disc.apply(d_params, pred))


def test_adversarial_trainer_step_matches_optax():
  codec, jcodec = codecs.MelGan(), jax_codecs.MelGan()
  cfg = dict(base_channels=32)
  jt = jax_train.AdversarialVocoderTrainer(
      jax_vocoder.SoundStreamDecoder(config=jax_vocoder.SoundStreamConfig(
          **cfg)), jcodec)
  state = jax.jit(lambda key: jt.create_state(key, mel_frames=8))(
      jax.random.PRNGKey(0))
  # The step donates state: keep the starting weights as numpy.
  g0, d0 = (jax.tree.map(np.array, t) for t in (state.g_params,
                                                 state.d_params))
  mel, audio = _batch(8, seed=5)
  jm, ja = jnp.asarray(mel), jnp.asarray(audio)
  want_gg = jax.jit(jax.grad(
      lambda g: _jax_g_loss(jt, g, d0, jm, ja)))(g0)
  new_state, want_m = jt.train_step(state, jm, ja)
  # The discriminator's gradient on the UPDATED generator's audio (JAX's,
  # fed to both sides: the generator's float32 rounding would otherwise
  # move pre-activations across the leaky ReLUs' kink).
  pred = np.asarray(jt.decoder.apply(new_state.g_params, jm))
  want_dg = jax.jit(jax.grad(lambda d: _jax_d_loss(jt, d, pred, ja)))(d0)
  decoder = vocoder.SoundStreamDecoder(vocoder.SoundStreamConfig(**cfg))
  decoder.load_state_dict(convert.flax_convs_to_state_dict(
      jax.tree.map(np.asarray, g0["params"]), decoder))
  pt = vocoder_train.AdversarialVocoderTrainer(decoder, codec, device="cpu")
  pt.disc.load_state_dict(convert.flax_convs_to_state_dict(
      jax.tree.map(np.asarray, d0["params"]), pt.disc))
  st = pt.create_state(seed=None)
  tm, ta = torch.from_numpy(mel), torch.from_numpy(audio)
  g_total, _ = pt.g_loss_fn(tm, ta)
  _check_grads(vocoder_train._grads(g_total, st.g_params),
               want_gg["params"], "generator grad")
  # The generator's loss leaves no gradient on the discriminator.
  assert all(p.grad is None for p in pt.disc.parameters())
  st, got_m = pt.train_step(st, mel, audio)
  _check_metrics(got_m, want_m)
  _check_params(st.g_params, new_state.g_params["params"], 1e-4,
                want_gg["params"], "generator")
  _check_params(st.d_params, new_state.d_params["params"], 1e-4,
                want_dg["params"], "discriminator")
  assert _moved(g0, new_state.g_params) and _moved(d0, new_state.d_params)
  # The discriminator's gradient: the starting discriminator on the
  # updated generator's audio.
  disc = pt.disc
  disc.load_state_dict(convert.flax_convs_to_state_dict(
      jax.tree.map(np.asarray, d0["params"]), disc))
  d_loss = discriminators.hinge_d_loss(disc(ta), disc(torch.from_numpy(pred)))
  _check_disc_grads(
      vocoder_train._grads(d_loss, dict(disc.named_parameters())),
      want_dg["params"], "discriminator grad")


def _clips(count, seed=3):
  r = np.random.RandomState(seed)
  for _ in range(count):
    yield (r.randn(int(r.randint(2000, 9000))) * 0.2).astype(np.float32)


def test_vocoder_batches_match_jax():
  jcodec, codec = jax_codecs.MelGan(), codecs.MelGan()
  want = list(jax_train.vocoder_batches(_clips(12), jcodec,
                                        segment_frames=16, batch_size=3,
                                        seed=7))
  got = list(vocoder_train.vocoder_batches(_clips(12), codec,
                                           segment_frames=16, batch_size=3,
                                           seed=7))
  assert len(got) == len(want) >= 2  # clips under 16 x 320 are skipped
  for (gm, ga), (wm, wa) in zip(got, want):
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=MEL_TOL,
                               atol=MEL_TOL)


def test_prefetch_keeps_order_and_reraises():
  assert list(vocoder_train.prefetch(iter(range(50)), depth=3)) == list(
      range(50))

  def failing():
    yield 1
    yield 2
    raise RuntimeError("producer failed")

  it = vocoder_train.prefetch(failing(), depth=1)
  assert next(it) == 1 and next(it) == 2
  with pytest.raises(RuntimeError, match="producer failed"):
    next(it)


def test_adamw_matches_optax_with_betas():
  r = np.random.RandomState(2)
  params = {"a": r.randn(7, 5).astype(np.float32),
            "b": r.randn(3).astype(np.float32)}
  tx = optax.adamw(3e-3, b1=0.5, b2=0.9)
  jp = {k: jnp.asarray(v) for k, v in params.items()}
  js = tx.init(jp)
  opt = trainer.AdamW(trainer.constant_schedule(3e-3), b1=0.5, b2=0.9)
  tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  ts = opt.init(tp)
  for _ in range(4):
    g = {k: r.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
    jp = optax.apply_updates(jp, updates)
    ts = opt.step_(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
  for k in params:
    np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                               atol=1e-7, err_msg=k)


def test_create_state_is_seeded_and_magnitude_head_starts_at_zero():
  codec = codecs.MelGan()
  a = vocoder_train.MagnitudeTrainer(vocoder.MagnitudeNet(hidden=8), codec,
                                     device="cpu").create_state(seed=3)
  b = vocoder_train.MagnitudeTrainer(vocoder.MagnitudeNet(hidden=8), codec,
                                     device="cpu").create_state(seed=3)
  for k in a.params:
    assert torch.equal(a.params[k], b.params[k]), k
  assert not a.params["conv_out.weight"].any()
  assert a.params["conv_in.weight"].any()
  mel = torch.from_numpy(_batch(4, rows=1)[0])
  net = vocoder.MagnitudeNet(hidden=8)
  with torch.no_grad():
    base = torch.clamp(torch.exp(mel) @ net.pinv, min=0.0)
    torch.testing.assert_close(net(mel), base, rtol=0, atol=0)


def test_as_codec_decoder_keeps_the_decoder_trainable():
  dec = vocoder.SoundStreamDecoder(vocoder.SoundStreamConfig(
      base_channels=32))
  pt = vocoder_train.VocoderTrainer(dec, codecs.MelGan(), device="cpu")
  st = pt.create_state(seed=0)
  codec = codecs.MelGan()
  codec.set_vocoder(*pt.as_codec_decoder(st))
  out = codec.decode(torch.zeros(1, 4, 128))
  assert tuple(out.shape) == (1, 4 * 320)
  assert all(p.requires_grad for p in dec.parameters()) and dec.training
  st, metrics = pt.train_step(st, *_batch(4, rows=1))
  assert np.isfinite(metrics["loss"].item())
